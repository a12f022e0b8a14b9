"""Retired serving shim (twin of ``repro.runtime.serving``): frame serving
lives on `repro_torch.api.SREngine`.

    from repro_torch.api import SREngine, ExecutionPlan
    engine = SREngine.from_config(cfg, plan=ExecutionPlan(), switching=sw)
    for result in engine.stream(frames): ...
"""
from __future__ import annotations


def FrameServer(*args, **kwargs):
    raise RuntimeError(
        "runtime.serving.FrameServer was removed: construct "
        "repro_torch.api.SREngine and use engine.stream(frames) (or "
        "engine.serve(frame) one frame at a time)")
