"""Device interval of the port's ``c2m.flow.output`` span per profiled
request of the flow tool: from the end of the inference on the device to
the last flow and confidence copied to the host (CUDA events at the span's
edges). None in other cells."""

from perfbench import flow_spans

UNIT = "ms"


def read(run):
    return flow_spans.mean_per_request(run, "c2m.flow.output", "device_ms")
