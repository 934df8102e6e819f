"""The port's launch layer: fake-group production meshes (``mesh``),
meta-tensor step inputs (``specs``), per-device op accounting
(``op_analysis``) and the dry run (``dryrun``)."""
