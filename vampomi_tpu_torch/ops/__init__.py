"""Design operator, LMMSE solvers and the hand-written CUDA kernels."""
