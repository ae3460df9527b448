"""The whole step: the counted float operations of the window's work over
the window's time and the card's float32 peak, %. The count comes from
the configuration's widths and the frozen work table (work/flops.py), as
the cell's kind gives it per unit of work. Split by the end-to-end
metric it moves."""


def read(bundle):
    record, flops = bundle["record"], bundle.get("flops_per_unit")
    if not flops or not record.get("seconds"):
        return None
    return (100.0 * flops * record["units"] / record["seconds"]
            / bundle["peaks"]["fp32_flops_per_s"])
