"""Compute core: flattening, secular functions, dispersion, kernels."""
