"""Hand-written Hopper kernels for the planned matmul, each beside its
plain PyTorch version.

skew_matmul  — the dense schedule family (k_inner / a_resident /
               b_resident) and its batched grid, with fused epilogues
gemv_splitk  — the two-pass split-K GEMV for decode rows
ops          — planned wrappers (plan, clip blocks, dispatch)
ref          — plain oracles
build        — nvcc build + ctypes loading of `csrc/`
"""
