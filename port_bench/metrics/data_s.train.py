"""data_s.train (s): the trainer's data section (Trainer.last_timings
["data_s"]: the loader, the transfer, the normalisation and the streaming
VAE encode, ending in a synchronize), summed over the window's iterations
and divided by their count."""


def read(r):
    if r["kind"] != "train" or not r["units"]:
        return None
    return r["data_s"]
