"""The port's device probe (``copycat_tpu_torch/utils/platform.py``
``require_devices``): bounded probes in child processes, exit 2 when
they are spent, no probe for the CPU, and no way back to the CPU when
the card was asked for. Without a card the real probe fails; the
healthy case runs a stand-in probe and bind."""

import pytest

pytest.importorskip("torch")

from copycat_tpu_torch.utils import knobs, platform  # noqa: E402


@pytest.fixture(autouse=True)
def unverified(monkeypatch):
    """Each case starts with no verified card (and leaves none)."""
    monkeypatch.setattr(platform, "_devices_verified", False)


def test_real_probe_fails_without_a_card_and_exits_2(monkeypatch, capsys):
    monkeypatch.setenv("COPYCAT_DEVICE_PROBES", "1")
    with pytest.raises(SystemExit) as exc:
        platform.require_devices(retry_wait_s=0.0)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "probe 1/1: the card did not answer" in err
    assert "is_available() is False" in err and "--device cpu" in err


def test_probes_are_exhausted_then_exit_2(monkeypatch, capsys):
    monkeypatch.setattr(platform, "_PROBE_CODE", "raise SystemExit(1)")
    monkeypatch.setenv("COPYCAT_DEVICE_PROBES", "3")
    with pytest.raises(SystemExit) as exc:
        platform.require_devices("cuda", retry_wait_s=0.0)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert [f"probe {i}/3" in err for i in (1, 2, 3)] == [True] * 3
    assert not platform._devices_verified


def test_a_hung_probe_is_cut_by_its_timeout(monkeypatch, capsys):
    monkeypatch.setattr(platform, "_PROBE_CODE",
                        "import time; time.sleep(30)")
    monkeypatch.setenv("COPYCAT_BENCH_DEVICE_TIMEOUT", "0.3")
    monkeypatch.setenv("COPYCAT_DEVICE_PROBES", "1")
    with pytest.raises(SystemExit) as exc:
        platform.require_devices(env="COPYCAT_BENCH_DEVICE_TIMEOUT")
    assert exc.value.code == 2
    assert "no response within" in capsys.readouterr().err


def test_a_healthy_probe_passes_and_binds_once(monkeypatch):
    binds = []
    monkeypatch.setattr(platform, "_PROBE_CODE", "print('1 stand-in card')")
    monkeypatch.setattr(platform, "_bind", lambda: binds.append(1) or 1)
    platform.require_devices()
    assert platform._devices_verified and binds == [1]
    platform.require_devices("cuda")      # verified once per process
    assert binds == [1]


def test_a_failed_bind_after_a_healthy_probe_exits_2(monkeypatch):
    def broken():
        raise RuntimeError("context lost")

    monkeypatch.setattr(platform, "_PROBE_CODE", "print('1 stand-in card')")
    monkeypatch.setattr(platform, "_bind", broken)
    with pytest.raises(SystemExit) as exc:
        platform.require_devices()
    assert exc.value.code == 2
    assert not platform._devices_verified


@pytest.mark.parametrize("device", ["cpu", "cpu:0"])
def test_the_cpu_skips_the_probe(device, monkeypatch):
    def no_child(*a, **kw):
        raise AssertionError("probed for the CPU")

    monkeypatch.setattr(platform.subprocess, "run", no_child)
    platform.require_devices(device)
    assert not platform._devices_verified


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0"])
def test_no_path_returns_when_the_card_was_asked_for(device, monkeypatch):
    monkeypatch.setattr(platform, "_PROBE_CODE", "raise SystemExit(1)")
    monkeypatch.setenv("COPYCAT_DEVICE_PROBES", "1")
    with pytest.raises(SystemExit) as exc:
        platform.require_devices(device)
    assert exc.value.code == 2


@pytest.mark.parametrize("name,default", [
    ("COPYCAT_DEVICE_TIMEOUT", 120.0), ("COPYCAT_DEVICE_PROBES", 5),
    ("COPYCAT_BENCH_DEVICE_TIMEOUT", 120.0)])
def test_probe_knobs_are_declared(name, default):
    assert knobs.REGISTRY[name].default == default
    assert knobs.REGISTRY[name].section == "platform"
