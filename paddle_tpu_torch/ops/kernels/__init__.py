"""Hand-written Hopper kernels of the port, one module each, with their
plain PyTorch versions and launch counters.  Sources are in ``csrc/``;
``_build`` compiles them on first use."""
