"""Model assembly of the port: embedding prologue, encoder and decoder
stacks, logits, prefill, the decode step, and the paged decode forward."""
