"""The state step's (K1's) bytes: the blob read and written once, the
actions read once, and its tables read once (the reference's own tables,
built from the map)."""

TABLES = ("words", "ct_t", "ot", "bank", "prm", "npc", "colmap", "drp",
          "n_ok_v", "n_driv")


def k1_bytes(st, nf, B):
    """st: the reference's device tables (reference.fused.build)."""
    tab = sum(st[k].numel() * st[k].element_size() for k in TABLES) + (
        st["goal"].numel() * 4 if st["nav"] else 0)
    return 2 * nf * B * 4 + 2 * B * 4 + tab
