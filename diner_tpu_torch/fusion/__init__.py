"""Depth-map filtering and fusion into point clouds: the numpy
reprojection-consistency backends (``consistency.py``) and the C++/OpenMP
library of the gipuma backend (``fusion.py``)."""
