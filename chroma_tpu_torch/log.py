"""Framework logger (reference: chroma/log.py)."""
import logging

logger = logging.getLogger("chroma_tpu_torch")
logger.addHandler(logging.NullHandler())
