"""Single-device step functions, the training and serving CLIs, and the LM
accounting (``graphs``: a model as a task graph; ``analytic``: FLOPs and
bytes per step).  The mesh and the dry-run wait (ROADMAP Queue 1 item 8)."""
