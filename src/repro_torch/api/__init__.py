"""The port's serving facade: `SREngine`, `ExecutionPlan`, `FrameResult`."""
from repro_torch.api.engine import SREngine
from repro_torch.api.plan import ExecutionPlan
from repro_torch.api.result import FrameResult

__all__ = ["ExecutionPlan", "FrameResult", "SREngine"]
