"""Device-side operations of the torch port (layout of chroma_tpu.ops)."""
