"""Demos of the port: ``demo`` (a spinning scene to PNGs) and ``multichip``
(tile and two-level meshes over spawned gloo ranks)."""
