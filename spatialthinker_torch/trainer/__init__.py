"""The trainer: the ``GRPOTrainer`` class and its CLI (``main.py``), the update
step and optimizer, metrics, tracker and checkpoints (counterpart of
``spatialthinker_tpu/trainer``)."""
