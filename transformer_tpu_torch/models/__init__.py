"""Model assembly of the port: embedding prologue, decoder stack, logits,
prefill, and the paged decode forward."""
