"""attn_tail's share of its roofline over the traced window: the least time its
launches need (the yardstick's counts from each launch's shapes and lengths,
against the card's peak bandwidth and the peak of its precision) over their
device time by kernel name. None where the window ran no such launch."""


def read(rec):
    least = rec.get("kernel_least_s", {}).get("attn_tail")
    spent = rec.get("kernel_s", {}).get("attn_tail")
    if not least or not spent:
        return None
    return 100.0 * least / spent
