"""Graph ops of the port: masked segment ops, the NK slot and CSR edge
layouts, edge attention, and the kernels (fused GraphNetBlock and edge
attention on either layout, gated FFN) with their plain PyTorch versions
and their build."""
