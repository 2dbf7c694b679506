"""Llama-family model pieces: layers, params, LAQ model quantization."""
