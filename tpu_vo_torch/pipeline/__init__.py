from tpu_vo_torch.pipeline.step import VOState, VOStepOutput, vo_step, initial_state
from tpu_vo_torch.pipeline.runner import run_sequence_scan, run_sequence_batched

__all__ = [
    "VOState",
    "VOStepOutput",
    "vo_step",
    "initial_state",
    "run_sequence_scan",
    "run_sequence_batched",
]
