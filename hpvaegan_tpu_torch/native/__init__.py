"""The native runner of the exported sampler (runner.cc on libtorch) and
its build helper (build.py)."""
