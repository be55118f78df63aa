from . import vis, xdmfutils
