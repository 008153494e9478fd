"""The port's golden references, NumPy and C++, none of them torch:

- ``cpu_reference``: the NumPy float32 spec every frame of the port is held
  to bit for bit;
- ``aet_reference``: the reference's literal model-level active-edge walk;
- ``native``: the ctypes binding to ``native/golden.cpp``, the C++
  renderer that is the CPU baseline.
"""
