"""dtown_torch.utils.viewer.LiveViewer, the MJPEG server (counterpart of
dtown/utils/viewer.py), end to end with a real HTTP client: a snapshot,
the page, the caption, a 404, and a stream that delivers a second frame.
The stream test publishes the second frame only after the viewer signals
that the first went out to the client (wait_sent), and reads against a
deadline, so it has no fixed timer to race."""
import io
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch


@pytest.fixture()
def viewer():
    pytest.importorskip("PIL")
    from dtown_torch.utils.viewer import LiveViewer

    v = LiveViewer(port=0, host="127.0.0.1")
    yield v
    v.close()


def _get(port, path, timeout=10):
    return urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                  timeout=timeout)


def test_snapshot_caption_page_and_404(viewer):
    from PIL import Image

    frame = torch.zeros((32, 48, 3), dtype=torch.uint8)
    frame[:, :, 0] = 200
    viewer.update(frame, caption="hello")  # a tensor is accepted
    with _get(viewer.port, "/frame.jpg") as r:
        assert r.headers["Content-Type"] == "image/jpeg"
        img = np.asarray(Image.open(io.BytesIO(r.read())))
    assert img.shape == (32, 48, 3)
    # JPEG is lossy; the dominant channel survives
    assert img[..., 0].mean() > 150 and img[..., 1].mean() < 60
    with _get(viewer.port, "/caption") as r:
        assert r.read().decode() == "hello"
    viewer.update(np.zeros((8, 8), np.uint8))  # grayscale accepted
    with _get(viewer.port, "/") as r:
        assert "/stream" in r.read().decode()
    with pytest.raises(urllib.error.HTTPError) as e:
        _get(viewer.port, "/nope")
    assert e.value.code == 404


def test_mjpeg_stream_delivers_updates(viewer):
    viewer.update(np.full((16, 16, 3), 10, np.uint8))
    r = _get(viewer.port, "/stream")
    assert "multipart/x-mixed-replace" in r.headers["Content-Type"]
    assert viewer.wait_sent(1, timeout=30), "the first frame never went out"
    viewer.update(np.full((16, 16, 3), 240, np.uint8))
    deadline = time.monotonic() + 30
    data = b""
    while data.count(b"Content-Type: image/jpeg") < 2:
        assert time.monotonic() < deadline, "no second frame in 30 s"
        chunk = r.read1(65536)
        assert chunk, "stream ended early"
        data += chunk
    r.close()
    assert viewer.wait_sent(2, timeout=30)
    assert viewer.seq == 2
