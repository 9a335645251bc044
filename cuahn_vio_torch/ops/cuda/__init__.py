"""Hand-written CUDA kernels for Hopper and their launch counters.

Each kernel's wrapper adds one to ``launch_counts[name]`` where it
launches the kernel, and nowhere else, so a run can show that its main
path went through the kernel.
"""

launch_counts = {
    "homography_warp": 0,  # B1 (B = 1) and B2 (B > 1): warp_kernel
    "homography_warp_rowskip": 0,  # B3: rowskip_kernel
    "bilinear_sample": 0,  # B4: flat_kernel
}


def reset_launch_counts() -> None:
    for name in launch_counts:
        launch_counts[name] = 0
