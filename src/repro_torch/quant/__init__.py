"""PAMS quantization of the port (twin of ``repro.quant``)."""
