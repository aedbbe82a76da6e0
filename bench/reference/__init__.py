"""Plain PyTorch references, one module per model family, found by the
family name a configuration file gives. Each computes its family's
forward pass in float32 (TF32 off) from the benchmark's weights and token
ids alone: it imports nothing of the port, takes nothing the port made,
and works positions, windows and states out again. ``quant="fp8"`` runs
the same pass with every matmul operand rounded to float8 e4m3 (per-row
activation and per-column weight scales): the control, one precision
below the bf16 the configurations state."""
