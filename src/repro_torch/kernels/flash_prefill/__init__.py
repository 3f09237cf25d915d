"""Prefill flash attention (port of the Pallas ``flash_prefill``)."""
