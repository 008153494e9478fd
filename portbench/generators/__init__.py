"""Scene generators, one file per kind a configuration names: each has
``build(params, rng)`` and returns NumPy arrays, never the program's."""
