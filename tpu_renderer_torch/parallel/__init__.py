"""Sharded rendering over a torch.distributed DeviceMesh (``mesh``)."""
