"""Host helpers of the format: bit packing, forcing flags, levels, roaring."""
