"""The benchmark's plain reference: a frozen copy of the NumPy spec
(``spec.py``) and its rendering on windows of a frame (``frame.py``).
NumPy only; it imports nothing of the program."""
