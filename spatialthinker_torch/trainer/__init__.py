"""The GRPO update path: optimizer, update step and per-step glue
(counterpart of ``spatialthinker_tpu/trainer``)."""
