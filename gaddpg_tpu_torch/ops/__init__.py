"""Point-cloud and physics ops: plain PyTorch versions and the CUDA kernels
behind them.

Every kernel wrapper here dispatches on the device of its input: a CPU
tensor runs the plain PyTorch version, a CUDA tensor launches the
hand-written kernel (built by `ops.build` at first use) or raises. There
is no switch, probe or fallback between the two.
"""
