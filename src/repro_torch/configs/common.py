"""Shared parallelism presets for the arch configs."""
from repro_torch.configs.base import ParallelConfig

PAR_BIG = ParallelConfig(batch_axes=("pod", "data"), model_axis="model",
                         fsdp_axis="data", seq_axis="model", remat="full")
PAR_SMALL = ParallelConfig(batch_axes=("pod", "data"), model_axis="model",
                           fsdp_axis=None, seq_axis="model", remat="full")
