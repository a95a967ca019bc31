"""SC2-PCR registration."""
