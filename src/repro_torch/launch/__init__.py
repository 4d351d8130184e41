"""Single-device step functions and the serving CLI.  The mesh, the
train step and the dry-run wait (ROADMAP)."""
