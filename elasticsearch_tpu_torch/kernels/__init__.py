"""Hand-written CUDA kernels of the port: build, load, launch counts
(``build.py``)."""
