"""The yardstick of the roofline shares: the card's peaks and the work a
kernel's task needs, counted from the task and not from the kernel's own
tiling, so the count stays the same whatever kernel does the task."""
