"""Paged decode attention (port of the Pallas ``flash_decode_paged``)."""
