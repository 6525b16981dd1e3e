"""State that lives on the host between its uses (counterpart of
``spatialthinker_tpu/parallel``; one process on one GPU, so of that package
only ``offload.py`` has a counterpart so far: the mesh, sharding and
multi-host modules come with the multi-GPU port)."""
