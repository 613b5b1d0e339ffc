"""Host staging copies (utils/streamio.py stream_to_host, slabs_to_device):
bytes of the trace's host<->device copies over their device time, GB/s."""


def read(run):
    moved = secs = 0.0
    for e in run.device_events():
        if e["cat"] == "gpu_memcpy" and ("HtoD" in e["name"] or "DtoH" in e["name"]):
            moved += float(e["args"].get("bytes", 0))
            secs += e["t1"] - e["t0"]
    return moved / secs / 1e9 if moved and secs else None
