from .binmat import read_bin_mat, write_bin_mat
from .cameras import Camera, read_camera, write_camera, read_pair, write_pair
from .ply import export_point_cloud, read_ply
from .cache import MemoryCache

__all__ = [
    "read_bin_mat", "write_bin_mat",
    "Camera", "read_camera", "write_camera", "read_pair", "write_pair",
    "export_point_cloud", "read_ply",
    "MemoryCache",
]
