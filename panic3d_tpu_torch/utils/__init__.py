from .imageops import dilation, erosion, resize_nearest, sobel_magnitude
