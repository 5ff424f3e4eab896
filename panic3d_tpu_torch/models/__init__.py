from .stylegan2 import (
    FullyConnectedLayer,
    Generator,
    MappingNetwork,
    SynthesisBlock,
    SynthesisLayer,
    SynthesisNetwork,
    ToRGBLayer,
)
from .superresolution import SR_MODULES
from .triplane import DEFAULT_RENDERING_KWARGS, OSGDecoder, TriPlaneGenerator
