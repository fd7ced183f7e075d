"""What decides ``correct``: every request served in the window, held to
the plain reference's logits of its image.

- ``failed``: requests due in the window whose logits never came, or are
  not finite, or have another shape than the reference's (limit 0);
- ``logit_gap``: over every served request, max |served - reference| /
  max |reference| of its logits row (the configuration's limit, set from
  the program's readings over seeds and the control's, ``PERF.md``).

The reference runs once the window has closed and the program is freed:
once a distinct image, in blocks, in float32 with TF32 off.
"""
from __future__ import annotations

import math

import torch

__all__ = ["reference_logits", "judge"]

BLOCK = 64


def reference_logits(cfg: dict, params: list, pool: torch.Tensor,
                     used: list, reference, device) -> dict:
    """{pool index: reference logits (classes,) f32 on the host}."""
    out = {}
    with torch.no_grad():
        for s in range(0, len(used), BLOCK):
            idx = used[s:s + BLOCK]
            y = reference.forward(cfg, params, pool[idx].to(device)).cpu()
            out.update(zip(idx, y))
    return out


def judge(run, ref: dict, cfg: dict) -> dict:
    """The numbers compared, each beside its limit, and the verdict."""
    ok_rows = [r for r in run.requests
               if isinstance(r.logits, torch.Tensor)
               and r.logits.shape == ref[r.pool_idx].shape]
    gap = 0.0
    failed = len(run.requests) - len(ok_rows)
    if ok_rows:
        n = len(ok_rows)
        y = torch.stack([r.logits for r in ok_rows]).float().reshape(n, -1)
        finite = torch.isfinite(y).all(1)
        failed += int((~finite).sum())
        want = torch.stack([ref[r.pool_idx] for r in ok_rows]).reshape(n, -1)
        scale = want.abs().amax(1).clamp_min(1e-30)
        rows = ((y - want).abs().amax(1) / scale)[finite]
        gap = float(rows.max()) if len(rows) else 0.0
    limit = cfg["correct"]["logit_gap"]
    compared = {"failed": {"value": failed, "limit": 0},
                "logit_gap": {"value": gap, "limit": limit}}
    ok = failed == 0 and limit is not None and math.isfinite(gap) \
        and gap <= limit and len(run.requests) > 0
    return dict(correct=bool(ok), attempted=len(run.requests),
                failed=failed, compared=compared)
