from .conventions import camera_label, euler_xyz_matrix, fov_to_focal, get_rays_ortho
from .rays import sample_rays
