"""The sparse-vision front end and the camera models.

Counterpart of ``cuahn_vio.vision``: grid-bucketed Shi-Tomasi detection
(``detect``), batched pyramidal KLT (``klt``), N-view triangulation
(``triangulate``) and IMU preintegration factors (``preint``), the
OpenVINS-inherited components of the reference, with all features of a
call as one batch; and the raw cameras' distortion models (``camera``).
The VIO pipeline itself runs none of them: ``track-features`` drives the
detector and the tracker.
"""

from cuahn_vio_torch.vision.detect import grid_detect, shi_tomasi_score
from cuahn_vio_torch.vision.klt import build_pyramid, track_pyramidal
from cuahn_vio_torch.vision.preint import PreintFactor, preintegrate
from cuahn_vio_torch.vision.triangulate import triangulate_nview

__all__ = [
    "shi_tomasi_score",
    "grid_detect",
    "build_pyramid",
    "track_pyramidal",
    "triangulate_nview",
    "preintegrate",
    "PreintFactor",
]
