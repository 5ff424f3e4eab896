from .conventions import cam60, camera_label, camsubs, euler_xyz_matrix, fov_to_focal, get_rays_ortho
from .rays import sample_rays
