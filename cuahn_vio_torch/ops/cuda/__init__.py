"""Hand-written CUDA kernels for Hopper and their launch counters.

Each kernel's wrapper adds one to ``launch_counts[name]`` where it
launches the kernel, and nowhere else, so a run can show that its main
path went through the kernel. T1's launches are also counted by draw mode
(``threefry_launches_by_mode``). A UAHN call replayed from CUDA graphs
(``models/uahn_graphs``) adds the launches its graphs captured, so the
counters read the same whether a call ran eagerly or was replayed;
``uahn_calls`` counts how each no-grad UAHN call ran.
"""

launch_counts = {
    "homography_warp": 0,  # B1 (B = 1) and B2 (B > 1): warp_kernel
    "homography_warp_rowskip": 0,  # B3: rowskip_kernel
    "bilinear_sample": 0,  # B4: flat_kernel
    "remap": 0,  # C1: remap_kernel (remap.cu), the undistortion remap
    "threefry": 0,  # T1: threefry_kernel (prng.cu), the JAX random stream
    "lowc_conv": 0,  # V1: lowc_conv_kernel (conv.cu), the towers' low-channel convolutions
    "conv_gemm": 0,  # V2: gemm_conv_kernel (conv_gemm.cu), the towers' other layers of blocks 2-4
    # V2's split path: gemm_conv_kernel and sum_gemm_conv_kernel, two a layer of 7x10 or 4x5 out
    "conv_gemm_split": 0,
    "mc_heads": 0,  # H1: mc_heads_gemm_kernel and mc_heads_tail_kernel (heads.cu), the heads
}

threefry_launches_by_mode = {  # T1's launches, by the mode of utils/prng.MODE_NAMES
    "bits": 0, "uniform": 0, "bernoulli": 0, "normal": 0, "truncated_normal": 0,
}

LAUNCH_COUNTERS = (launch_counts, threefry_launches_by_mode)

uahn_calls = {  # UAHN.forward's calls, by how each ran
    "eager": 0,  # op by op: on the CPU, with the error map, a key's first call
    "captured": 0,  # captured into one CUDA graph a stage (and then replayed)
    "replayed": 0,  # replayed from its stages' graphs (the captured call too)
}


def reset_launch_counts() -> None:
    for counts in (*LAUNCH_COUNTERS, uahn_calls):
        for name in counts:
            counts[name] = 0
