"""Step functions (one device or a mesh), the training and serving CLIs,
the LM accounting (``graphs``: a model as a task graph; ``analytic``:
FLOPs and bytes per step), and the sharded and dry-run parts: ``mesh``,
``shardings`` (the placement rules), ``pipeline`` (GPipe over the pod
axis), ``plan`` (the partitioner on a cell), ``hlo_analysis`` and
``dryrun``."""
from .mesh import make_production_mesh
