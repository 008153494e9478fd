"""The one traffic generator: a viewer orbiting the scene, one frame in
flight, each frame's rotation drawn from a traffic file's parameters.

Every seed gets the same set of angles (``steps_per_turn`` of a turn, each
once a turn), starting at an index drawn from the seed, so seeds change
the order of the work and not the work."""

from __future__ import annotations

import numpy as np

F = np.float32
AXES = {"x": (1, 2), "y": (2, 0), "z": (0, 1)}


def rotation(axis: str, angle: float) -> np.ndarray:
    """3x3 f32 rotation by ``angle`` about ``axis``, computed in float64
    and rounded once: (x, y, z) -> for y: (c x + s z, y, -s x + c z)."""
    i, j = AXES[axis]
    m = np.eye(3)
    c, s = np.cos(angle), np.sin(angle)
    m[i, i], m[i, j], m[j, i], m[j, j] = c, -s, s, c
    return m.astype(F)


class Orbit:
    """Frame i's rotation is ``matrices[index(i)]``; warm-up frames take
    negative i."""

    def __init__(self, mix: dict, rng):
        if mix.get("frames_in_flight", 1) != 1:
            raise ValueError("the generator runs one frame in flight")
        orbit = mix["orbit"]
        self.steps = int(orbit["steps_per_turn"])
        self.matrices = np.stack([
            rotation(orbit["axis"], 2.0 * np.pi * k / self.steps)
            for k in range(self.steps)])
        self.start = int(rng.integers(self.steps))

    def index(self, i: int) -> int:
        return (self.start + i) % self.steps
