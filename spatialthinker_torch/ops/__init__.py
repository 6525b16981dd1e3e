"""Attention ops of the port: ``attention`` (the model's entry point),
``flash_attention.flash_fwd`` and ``decode_attention`` (CUDA kernel wrappers
with their plain PyTorch versions). Import from the submodules: some of their
main functions share the submodules' names."""
