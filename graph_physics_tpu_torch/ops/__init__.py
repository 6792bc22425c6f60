"""Graph ops of the port: masked segment ops, the NK slot layout, edge
attention, and the kernels (fused GraphNetBlock, NK edge attention, gated
FFN) with their plain PyTorch versions and their build."""
