"""The benchmark's plain reference: a frozen copy of the port's model code
(``models/``, ``nn/``, ``renderer/``, ``ops/``, ``losses/``, ``geometry/``,
``utils/resize.py``) in which every hand-written kernel is replaced by its
plain PyTorch operation (the row gather by ``index_select``, compositing
by ``ops/composite.py``, the nearest-vertex search by a chunked brute
force), with ``precision.py``'s hooks for the controls and ``steps.py``'s
training step and render. It imports nothing of the program; the module
docstrings are the copied ones and name the port's files they came from.
"""
