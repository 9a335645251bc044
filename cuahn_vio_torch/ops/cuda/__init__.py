"""Hand-written CUDA kernels for Hopper and their launch counters.

Each kernel's wrapper adds one to ``launch_counts[name]`` where it
launches the kernel, and nowhere else, so a run can show that its main
path went through the kernel. T1's launches are also counted by draw mode
(``threefry_launches_by_mode``).
"""

launch_counts = {
    "homography_warp": 0,  # B1 (B = 1) and B2 (B > 1): warp_kernel
    "homography_warp_rowskip": 0,  # B3: rowskip_kernel
    "bilinear_sample": 0,  # B4: flat_kernel
    "remap": 0,  # C1: remap_kernel (remap.cu), the undistortion remap
    "threefry": 0,  # T1: threefry_kernel (prng.cu), the JAX random stream
}

threefry_launches_by_mode = {  # T1's launches, by the mode of utils/prng.MODE_NAMES
    "bits": 0, "uniform": 0, "bernoulli": 0, "normal": 0, "truncated_normal": 0,
}


def reset_launch_counts() -> None:
    for counts in (launch_counts, threefry_launches_by_mode):
        for name in counts:
            counts[name] = 0
