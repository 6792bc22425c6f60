"""Models of the port: layers, normalizer, EncodeProcessDecode, Simulator."""
