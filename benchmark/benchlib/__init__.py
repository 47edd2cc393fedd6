"""The benchmark's own library: discovery by name, the whole-unit window,
the result line, the table of peaks, the FLOP and byte counts, the trace
reader and the weight maker.  Nothing here imports JAX or the JAX package;
only ``kinds/`` imports the PyTorch port, and only the modules it drives."""
