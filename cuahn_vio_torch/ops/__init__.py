from cuahn_vio_torch.ops.quat import (  # noqa: F401
    skew,
    quat_mul,
    quat_exp,
    quat_log,
    quat_conj,
    quat_normalize,
    quat_to_rot,
    rot_to_quat,
    jr_so3,
    quat_rotate,
)
from cuahn_vio_torch.ops.homography import (  # noqa: F401
    corner_points,
    dlt_solve,
    transfer_mean_var,
    block_diag_cov8,
    f32_parity_mode,
)
from cuahn_vio_torch.ops.warp import (  # noqa: F401
    virtual_cam_k,
    pixel_grid_uv1,
    homography_warp,
    homography_warp_plain,
    bilinear_sample,
    bilinear_sample_flat,
)
