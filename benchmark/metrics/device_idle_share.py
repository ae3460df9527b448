"""Device layer (the H100): the share of the traced stretch in which no
kernel, copy or set ran on the card, %: 1 - busy / stretch, both from the
same profiled stretch. Split by the end-to-end metric it moves."""


def read(bundle):
    trace = bundle.get("trace")
    if not trace or trace["window_s"] <= 0 or trace["device_events"] == 0:
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
