"""LAQ quantizer, CSD cost tables and the split-brain traffic model."""
