"""Independent CPU reference implementation (NumPy/SciPy), used the way the
reference project uses g2o: a golden implementation for per-iteration chi2
parity checks (reference: samples/sample_comparison_with_g2o.cpp)."""
