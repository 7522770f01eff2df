"""dtown_torch.utils.checkpoint against the reference's checkpoint
semantics (dtown/utils/checkpoint.py, tests/test_train_resume.py):
rotating slots, pruning oldest first and never the pointee, the LATEST
pointer, numbering past the surviving slots when LATEST is lost, legacy
A/B slots, a save killed between its slot and its pointer, and a whole
training state (network, Adam, EnvState, generator) through torch's
weights_only loader and back into a live template."""
import os
import shutil

import pytest
import torch

from dtown_torch import EnvConfig, load_map
from dtown_torch.learn.ppo import PPOConfig, make_ppo
from dtown_torch.utils import checkpoint


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _it(path):
    return int(checkpoint.restore_any(path)["it"])


def test_save_atomic_keep_rotation(tmp_path):
    """keep=3 of five saves: the newest three slots, oldest first; the
    pointer names the newest and every kept slot restores to its own
    iteration."""
    base = str(tmp_path / "ck")
    for i in range(5):
        checkpoint.save_atomic(base, {"it": i}, keep=3)
    kept = checkpoint.slots(base)
    assert [os.path.basename(d) for d in kept] == \
        ["s000002", "s000003", "s000004"]
    assert checkpoint.resolve(base) == kept[-1]
    assert _it(base) == 4
    assert [_it(d) for d in kept] == [2, 3, 4]
    checkpoint.save_atomic(base, {"it": 5}, keep=0)  # keep >= 1
    assert [os.path.basename(d) for d in checkpoint.slots(base)] == \
        ["s000005"]


def test_lost_pointer_numbers_past_surviving_slots(tmp_path):
    """With LATEST gone the next slot is numbered past the highest
    surviving one, so rotation and pruning keep their order."""
    base = str(tmp_path / "ck")
    for i in range(3):
        checkpoint.save_atomic(base, {"it": i}, keep=2)
    os.remove(os.path.join(base, "LATEST"))
    checkpoint.save_atomic(base, {"it": 9}, keep=2)
    assert [os.path.basename(d) for d in checkpoint.slots(base)] == \
        ["s000002", "s000003"]
    assert _it(base) == 9


def test_legacy_ab_slots_migrate(tmp_path):
    """A two-slot (A/B) directory keeps working: the next save rotates
    into the numbered sequence and the pointer still resolves."""
    base = str(tmp_path / "ck")
    checkpoint.save_atomic(base, {"it": 7})
    shutil.move(checkpoint.resolve(base), os.path.join(base, "A"))
    with open(os.path.join(base, "LATEST"), "w") as f:
        f.write("A")
    assert _it(base) == 7
    checkpoint.save_atomic(base, {"it": 8}, keep=2)
    assert _it(base) == 8
    assert [os.path.basename(d) for d in checkpoint.slots(base)] == \
        ["A", "s000001"]


def test_save_killed_between_slot_and_pointer(tmp_path, monkeypatch):
    """A save that dies after writing its slot, before flipping LATEST,
    leaves the previous snapshot as the one restored; the next save
    numbers past the orphan slot and prunes it in order."""
    base = str(tmp_path / "ck")
    checkpoint.save_atomic(base, {"it": 1})
    real = os.replace

    def dies_at_pointer(src, dst):
        if os.path.basename(dst) == "LATEST":
            raise KeyboardInterrupt("killed")
        return real(src, dst)

    monkeypatch.setattr(checkpoint.os, "replace", dies_at_pointer)
    with pytest.raises(KeyboardInterrupt):
        checkpoint.save_atomic(base, {"it": 2})
    monkeypatch.setattr(checkpoint.os, "replace", real)
    assert _it(base) == 1
    assert [os.path.basename(d) for d in checkpoint.slots(base)] == \
        ["s000000", "s000001"]
    checkpoint.save_atomic(base, {"it": 3}, keep=2)
    assert _it(base) == 3
    assert [os.path.basename(d) for d in checkpoint.slots(base)] == \
        ["s000001", "s000002"]


def test_missing_checkpoint_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        checkpoint.restore_any(str(tmp_path / "nothing"))


def test_train_state_round_trip(tmp_path):
    """A step-path TrainState after one iteration (network, Adam moments,
    the nested EnvState, the generator) saved, loaded with
    weights_only=True, and restored into a fresh learner's state: every
    tensor equal, and the next iteration of both equal bit for bit."""
    cfg = EnvConfig(obs_type="state")
    ppo = PPOConfig(rollout_len=4, epochs=1, minibatches=2)
    init, train = make_ppo(cfg, load_map("small_loop"), 8, ppo,
                           device="cpu")
    ts, _ = train(init(torch.Generator().manual_seed(0)))
    tree = dict(net=ts.net, opt=ts.opt, env=ts.env_states,
                gen=ts.generator, it=1)
    checkpoint.save_atomic(str(tmp_path / "ck"), tree)
    raw = torch.load(os.path.join(checkpoint.resolve(str(tmp_path / "ck")),
                                  checkpoint.FILE), weights_only=True)
    assert raw["it"] == 1 and set(raw["env"]) >= {"pos", "dyn"}
    init2, train2 = make_ppo(cfg, load_map("small_loop"), 8, ppo,
                             device="cpu")
    fresh = init2(torch.Generator().manual_seed(5))
    got = checkpoint.restore(
        str(tmp_path / "ck"), dict(net=fresh.net, opt=fresh.opt,
                                   env=fresh.env_states, gen=fresh.generator,
                                   it=0))
    assert got["it"] == 1
    fresh = fresh._replace(env_states=got["env"])
    for a, b in zip(ts.net.parameters(), fresh.net.parameters()):
        assert torch.equal(a, b)
    ts, m = train(ts)
    fresh, m2 = train2(fresh)
    for a, b in zip(ts.net.parameters(), fresh.net.parameters()):
        assert torch.equal(a, b)
    assert torch.equal(ts.env_states.pos, fresh.env_states.pos)
    assert {k: float(v) for k, v in m.items()} == \
        {k: float(v) for k, v in m2.items()}


def test_generator_states_saved_side_by_side(tmp_path):
    """Generator states saved as views of one tensor (as a gather of the
    ranks' states gives them) restore each into its own generator, which
    then draws what the original does."""
    gens = [torch.Generator().manual_seed(s) for s in (1, 2)]
    stacked = torch.stack([g.get_state() for g in gens])
    checkpoint.save(str(tmp_path / "ck"), {"generators": list(stacked)})
    saved = checkpoint.restore_any(str(tmp_path / "ck"))["generators"]
    for g, s in zip(gens, saved):
        fresh = checkpoint.load_into(torch.Generator(), s)
        assert torch.equal(torch.rand(4, generator=fresh),
                           torch.rand(4, generator=g))
