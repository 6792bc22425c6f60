"""Core data structures of the port: node taxonomy, mesh graph, host mesh builders."""
