"""The benchmark's plain reference of ``HAVC_main``: a frozen copy of the
port's modules that the two configurations run, with its two CUDA kernels
replaced by their plain versions.  It imports torch, numpy and scipy only."""
