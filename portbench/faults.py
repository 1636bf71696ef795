"""What can stand in the program's place to prove that the check fails.

``control``: the plain reference in the nearest precision below the one the
configuration states (``control=True`` in the op's reference module).  The
faults break the timed path underneath in the ways a cell of this benchmark
can be broken; none of the cells runs on more than one chip, so no exchange
between chips can be left out.

* ``unchanged``: the op returns its input unchanged;
* ``half``: only the first half of each batch goes through the op, the rest
  comes back as it went in;
* ``altered``: one sample of every output is altered where it is produced
  (its bit 8 flipped: 256 steps).

A metric op (a configuration with ``compare``) takes two clips and gives
its result as a frame prop, so its faults act on the prop:

* ``unchanged``: the op returns its source clip, which carries no prop;
* ``half``: the op runs on the first half of each batch alone, so the prop
  holds the first half's values only;
* ``altered``: the first frame's value of the first compared prop is moved
  by ``ALTER_PROP`` (0.01: the two decimals SSIMULACRA2 scores are read at);
* ``control``: the reference's ``score`` in the lower precision.

Each is a ``wrap(op, cell)`` for ``harness.run_cell``; the op and the wraps
take the cell's clips as positional arguments.
"""

from __future__ import annotations

import torch

ALTER_PROP = 0.01


def control(op, cell):
    ref, cfg = cell.reference, cell.cfg
    if cell.metric:
        return lambda src, dist: src.with_props(**ref.score(src.planes, dist.planes, cfg,
                                                            control=True))
    return lambda clip: clip.with_planes(ref.run(clip.planes, cfg, control=True))


def unchanged(op, cell):
    return lambda *clips: clips[0]


def half(op, cell):
    def run(*clips):
        k = clips[0].planes[0].shape[0] // 2
        head = op(*(c.with_planes([p[:k] for p in c.planes]) for c in clips))
        if cell.metric:
            return head
        clip = clips[0]
        return clip.with_planes([torch.cat([h, p[k:]]) for h, p in zip(head.planes, clip.planes)])
    return run


def altered(op, cell):
    def run(*clips):
        out = op(*clips)
        if cell.metric:
            name = cell.cfg["compare"]["props"][0]
            v = out.props[name].clone()
            v[0] += ALTER_PROP
            return out.with_props(**{name: v})
        first = out.planes[0].clone()
        first[0, 0, 0] = (first[0, 0, 0].to(torch.int32) ^ 0x100).to(first.dtype)
        return out.with_planes((first,) + tuple(out.planes[1:]))
    return run


WRAPS = {"control": control, "unchanged": unchanged, "half": half, "altered": altered}
