"""The comparison that decides `correct`: a frame the window drew against
the reference's render of the same table and camera, both 8-bit.

Two numbers a frame, the worst over the frames compared:

  off1_share  the share of 8-bit colour channels that differ by more than
              one step (the port's float32 blend and the reference's round
              differently, so one step is rounding);
  max_step    the widest difference of one channel, in 8-bit steps.

Each has its limit in `limits/<cell>.json`, set from the sound runs'
readings and the bfloat16 control's (PERF.md gives both)."""

from __future__ import annotations

import torch

NUMBERS = ("off1_share", "max_step")


def compare(image_u8: torch.Tensor, ref_u8: torch.Tensor) -> dict:
    """The numbers of one frame: `image_u8` [H, W, 3 or 4] (alpha
    ignored), `ref_u8` [H, W, 3]."""
    d = (image_u8[..., :3].to(torch.int16) - ref_u8.to(image_u8.device).to(torch.int16)).abs()
    return {"off1_share": float((d > 1).float().mean()), "max_step": int(d.max())}


def worst(readings: list[dict]) -> dict:
    """The largest of each number over the frames' readings."""
    return {k: max(r[k] for r in readings) for k in NUMBERS}


def judge(readings: list[dict], limits: dict) -> tuple[bool, dict]:
    """(correct, {number: {"value", "limit"}}): correct where a frame was
    compared and every number is within its limit."""
    if not readings:
        return False, {k: {"value": None, "limit": limits[k]} for k in NUMBERS}
    w = worst(readings)
    checks = {k: {"value": w[k], "limit": limits[k]} for k in NUMBERS}
    return all(w[k] <= limits[k] for k in NUMBERS), checks
