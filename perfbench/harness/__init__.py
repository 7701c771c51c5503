"""The benchmark's general machinery: discovery by name, the device, the
window loop, the trace reduction and the result line."""
