"""FEA application layer: static-equilibrium mesh deformation with
hyperelastic materials (port of ``sanm_tpu/fea``)."""

from .material import EnergyModel, MaterialProperty, pk1  # noqa: F401
from .mesh import TetrahedralMesh  # noqa: F401
from .model import DeformableBody  # noqa: F401
from .remap import ForceOutputRemap, ShapeMatRemap  # noqa: F401
