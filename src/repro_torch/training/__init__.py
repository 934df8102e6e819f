"""Training stack of the port: the synthetic token pipeline (``data``),
AdamW (``optimizer``), checkpoints in the reference's on-disk format
(``checkpoint``) and the training step (``train``)."""
