"""The comparison that decides ``correct``.

After the window, the benchmark makes the sampled batches' input frames again
from the seed (never from what the program was handed, which it could have
written to) and runs the plain reference of the configuration's op over them,
a block of frames at a time, on the device the program ran on.  Each output
plane the program produced is compared with the reference's sample by sample:

* ``max_abs_lsb``: the largest |program - reference| over every compared
  sample, in steps of the sample type;
* ``off_share_pct``: the share of compared samples that differ at all, in
  percent.

Each is held to the limit the configuration states (``limits``).  A plane
whose shape or type differs reads as `FAR` off on every sample, and a run
that compared nothing as `FAR` and 100%.

A metric op's configuration names the frame props it compares (``compare``:
``{"props": [...]}``); its reference module's ``score`` gives them from both
clips' regenerated inputs, and ``compare_props`` reads

* ``max_abs_score``: the largest |program - reference| over every sampled
  frame's value of every named prop, in the prop's own units (points of the
  0-100 scale for SSIMULACRA2).

A prop that is missing, of another length than the batch, or not a finite
number on a frame reads `FAR`, and a run that compared nothing reads `FAR`.
"""

from __future__ import annotations

import torch

BLOCK = 8   # frames per reference call
FAR = 1e9   # the reading of a plane that cannot be compared


def compare(reference, cfg: dict, inputs: tuple, outputs: tuple, device) -> dict:
    """max |d|, differing samples and compared samples of one batch: the
    program's `outputs` (tensors or arrays) against the reference run on
    `inputs` (device tensors)."""
    max_abs, off, count = 0.0, 0, 0
    frames = inputs[0].shape[0]
    outs = [torch.as_tensor(o) for o in outputs]
    for o, x in zip(outs, inputs):
        if tuple(o.shape) != tuple(x.shape) or o.dtype != x.dtype:
            return {"max_abs": FAR, "off": x.numel(), "count": x.numel()}
    for f0 in range(0, frames, BLOCK):
        ref = reference.run(tuple(x[f0:f0 + BLOCK] for x in inputs), cfg)
        for o, r in zip(outs, ref):
            d = (o[f0:f0 + BLOCK].to(device, torch.int32) - r.to(torch.int32)).abs_()
            max_abs = max(max_abs, float(d.max()))
            off += int(torch.count_nonzero(d))
            count += d.numel()
    return {"max_abs": max_abs, "off": off, "count": count}


def compare_props(reference, cfg: dict, inputs: tuple, outputs: tuple, device) -> dict:
    """max |d| of one batch's props and the reference's values: the
    program's `outputs` (one value a prop named in ``cfg["compare"]``, or
    None where the op set none) against the reference's ``score`` of
    `inputs`, the (source, distorted) planes as device tensors."""
    source, distorted = inputs
    frames = source[0].shape[0]
    far = {"max_abs": FAR, "count": frames, "values": []}
    outs = []
    for o in outputs:
        if o is None:
            return far
        o = torch.as_tensor(o)
        if tuple(o.shape) != (frames,) or not torch.is_floating_point(o):
            return far
        outs.append(o.to(device, torch.float64))
    max_abs, values = 0.0, []
    for f0 in range(0, frames, BLOCK):
        ref = reference.score(tuple(x[f0:f0 + BLOCK] for x in source),
                              tuple(x[f0:f0 + BLOCK] for x in distorted), cfg)
        for name, o in zip(cfg["compare"]["props"], outs):
            r = ref[name].to(device, torch.float64)
            d = (o[f0:f0 + BLOCK] - r).abs_()
            if not bool(torch.isfinite(d).all()):
                return far
            max_abs = max(max_abs, float(d.max()))
            values += r.tolist()
    return {"max_abs": max_abs, "count": frames, "values": values}


def numbers(results: list, limits: dict, extra: dict | None = None) -> dict:
    """The compared numbers, each with its limit, from per-batch results."""
    if "max_abs_score" in limits:
        checks = {"max_abs_score": {"value": max((r["max_abs"] for r in results), default=FAR),
                                    "limit": limits["max_abs_score"]}}
        checks.update(extra or {})
        return checks
    count = sum(r["count"] for r in results)
    checks = {
        "max_abs_lsb": {"value": max((r["max_abs"] for r in results), default=FAR),
                        "limit": limits["max_abs_lsb"]},
        "off_share_pct": {"value": (100.0 * sum(r["off"] for r in results) / count
                                    if count else 100.0),
                          "limit": limits["off_share_pct"]},
    }
    checks.update(extra or {})
    return checks


def passed(checks: dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
