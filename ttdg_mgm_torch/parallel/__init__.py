"""Data parallelism on ``torch.distributed``: one process per GPU (NCCL),
or gloo ranks on the CPU; counterpart of ``ttdg_mgm_tpu/parallel/``."""
