"""Hand-written Hopper kernels, each beside its plain PyTorch version.

skew_matmul     — the dense schedule family (k_inner / a_resident /
                  b_resident) and its batched grid, with fused epilogues
gemv_splitk     — the two-pass split-K GEMV for decode rows
grouped_matmul  — the grouped expert GEMM of the MoE layers
flash_attention — prefill attention (causal, window, softcap, GQA / MQA)
rglru_scan      — the RG-LRU recurrence of the recurrent blocks' prefill
ssd_scan        — the Mamba-2 SSD chunked scan of the SSM blocks' prefill
block_sparse_matmul — the BSR matmul (k_inner / a_resident / b_resident)
ops             — public wrappers (plan, clip blocks, dispatch)
ref             — plain oracles
build           — nvcc build + ctypes loading of `csrc/`
"""
