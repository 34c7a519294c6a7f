"""The plain reference the benchmark judges the port by: PyTorch and NumPy in
float32 (int8 sums in float64, where they are exact), with TF32 off on the
card. It imports nothing of the port and takes nothing the port has made."""
