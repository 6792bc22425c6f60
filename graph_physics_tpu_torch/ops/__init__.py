"""Graph ops of the port: masked segment sums, the NK slot layout and the
fused GraphNetBlock kernel with its plain PyTorch version."""
