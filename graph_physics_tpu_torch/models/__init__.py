"""Models of the port: layers, normalizer, EncodeProcessDecode,
EncodeTransformDecode, Simulator."""
