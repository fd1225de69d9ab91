"""Frame-batched encoders (one device; a device mesh is not ported yet)."""
