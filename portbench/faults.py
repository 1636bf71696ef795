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

Each is a ``wrap(op, cell)`` for ``harness.run_cell``.
"""

from __future__ import annotations

import torch


def control(op, cell):
    ref, cfg = cell.reference, cell.cfg
    return lambda clip: clip.with_planes(ref.run(clip.planes, cfg, control=True))


def unchanged(op, cell):
    return lambda clip: clip


def half(op, cell):
    def run(clip):
        k = clip.planes[0].shape[0] // 2
        head = op(clip.with_planes([p[:k] for p in clip.planes]))
        return clip.with_planes([torch.cat([h, p[k:]]) for h, p in zip(head.planes, clip.planes)])
    return run


def altered(op, cell):
    def run(clip):
        out = op(clip)
        first = out.planes[0].clone()
        first[0, 0, 0] = (first[0, 0, 0].to(torch.int32) ^ 0x100).to(first.dtype)
        return out.with_planes((first,) + tuple(out.planes[1:]))
    return run


WRAPS = {"control": control, "unchanged": unchanged, "half": half, "altered": altered}
