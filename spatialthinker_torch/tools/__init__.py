"""Tools around the port's checkpoints: ``model_merger`` exports one to HF."""
