"""Host-side utilities of the port (corpus BLEU)."""
