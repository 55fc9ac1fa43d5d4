"""The plain reference: float64 products and residuals from the
benchmark's own host CSR (plain NumPy and PyTorch; nothing of the
program under test)."""
