"""Model stack of the port: shared layers, the decoder-only transformer
and the unified model API (``model``)."""
