from .bias_act import activation_funcs, bias_act
from .conv import conv2d_resample, modulated_conv2d
from .grid_sample import grid_sample_2d_points, grid_sample_3d_points
from .upfirdn2d import (
    downsample2d,
    filter2d,
    setup_filter,
    upfirdn2d,
    upfirdn2d_plain,
    upsample2d,
)
