"""Several GPUs and host-resident state (counterpart of
``spatialthinker_tpu/parallel``): ``mesh.py`` (the ``(data, fsdp, model)``
mesh of one process per GPU and its groups), ``sharding.py`` (FSDP2 over it),
``multihost.py`` (the process group and host data between ranks) and
``offload.py`` (host copies of device state)."""
