"""Model code of the port (dense causal transformer LM, decoding)."""
