from . import renderer
