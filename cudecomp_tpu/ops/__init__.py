"""Ops subpackage: transpose engine, halo engine, distributed FFT, stencils."""
