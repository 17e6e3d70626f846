"""AMR trees, space-filling curves and the Hercule codecs (host numpy)."""
