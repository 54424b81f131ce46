"""The port's native decode runtime (artgraph_tpu_torch/runtime) on the CPU.

The five cases of tests/test_runtime_native.py against the port's library,
built by g++ into a temporary build directory: the resize of random arrays
bit-exact with PIL's bilinear resize at four shapes, one JPEG's decode and
resize bit-exact with PIL (and with the JAX package's library), a
greyscale JPEG against PIL's RGB convert, a PNG refused (None), and a
threaded batch with a missing file's nonzero status. Then
`data.transforms.decode_resize_uint8`: the native path for a JPEG and PIL
for a PNG, both equal to PIL; and a library that cannot be built (a header
g++ cannot find) or is switched off (ARTGRAPH_NO_NATIVE): the decode falls
back to PIL, `native_available()` is False, `native_reason()` and one
logged warning say why.
"""
import logging

import numpy as np
import pytest
from PIL import Image

from artgraph_tpu.runtime import decode_resize_native as jax_decode_resize
from artgraph_tpu_torch.data import transforms
from artgraph_tpu_torch.runtime import (decode_batch_native,
                                        decode_resize_native,
                                        native_available, native_reason,
                                        resize_native)
from artgraph_tpu_torch.runtime import image_cpp


def _pil(path, size=224):
    return np.asarray(Image.open(path).convert("RGB").resize(
        (size, size), Image.BILINEAR))


@pytest.fixture(scope="module")
def built(tmp_path_factory):
    lib = image_cpp.NativeLibrary(tmp_path_factory.mktemp("build"))
    assert lib.load() is not None, lib.reason
    return lib


@pytest.fixture()
def native(built, monkeypatch):
    monkeypatch.setattr(image_cpp, "LIBRARY", built)
    assert native_available() and native_reason() is None
    return built


def test_library_is_built_under_its_hash(native):
    so = native.path()
    assert so.exists() and so.parent == native.build_dir
    assert so.name.startswith("libartdata-") and so.suffix == ".so"


@pytest.mark.parametrize("hw", [(60, 80), (224, 224), (500, 300), (37, 991)])
def test_resize_bit_exact_vs_pil(native, hw):
    img = np.random.default_rng(0).integers(0, 256, (*hw, 3), dtype=np.uint8)
    pil = np.asarray(Image.fromarray(img).resize((224, 224), Image.BILINEAR))
    np.testing.assert_array_equal(resize_native(img, 224), pil)


def test_decode_resize_bit_exact_vs_pil(native, tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "t.jpg")
    Image.fromarray(rng.integers(0, 256, (123, 217, 3), dtype=np.uint8)).save(
        path, quality=90)
    ours = decode_resize_native(path, 224)
    np.testing.assert_array_equal(ours, _pil(path))
    np.testing.assert_array_equal(ours, jax_decode_resize(path, 224))


def test_grayscale_jpeg_matches_pil_rgb_convert(native, tmp_path):
    rng = np.random.default_rng(2)
    path = str(tmp_path / "g.jpg")
    Image.fromarray(rng.integers(0, 256, (90, 120), dtype=np.uint8),
                    mode="L").save(path)
    np.testing.assert_array_equal(decode_resize_native(path, 224), _pil(path))


def test_png_falls_back_to_none(native, tmp_path):
    path = str(tmp_path / "p.png")
    Image.fromarray(np.zeros((20, 20, 3), np.uint8)).save(path)
    assert decode_resize_native(path, 224) is None


def test_decode_batch(native, tmp_path):
    rng = np.random.default_rng(3)
    paths = []
    for i in range(5):
        p = str(tmp_path / f"{i}.jpg")
        Image.fromarray(rng.integers(0, 256, (64 + i, 80, 3),
                                     dtype=np.uint8)).save(p, quality=92)
        paths.append(p)
    paths.append(str(tmp_path / "missing.jpg"))
    batch, status = decode_batch_native(paths, 224, threads=2)
    assert batch.shape == (6, 224, 224, 3) and status.dtype == np.int32
    assert list(status[:5]) == [0] * 5 and status[5] == 2
    for i, p in enumerate(paths[:5]):
        np.testing.assert_array_equal(batch[i], _pil(p))


def _jpeg_and_png(tmp_path):
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (150, 170, 3), dtype=np.uint8)
    jpg, png = str(tmp_path / "a.jpg"), str(tmp_path / "a.png")
    Image.fromarray(img).save(jpg, quality=90)
    Image.fromarray(img).save(png)
    return jpg, png


def test_transforms_take_native_for_jpeg_and_pil_for_png(native, tmp_path,
                                                         monkeypatch):
    jpg, png = _jpeg_and_png(tmp_path)
    pil_calls = []
    pil = transforms.decode_resize_pil
    monkeypatch.setattr(transforms, "decode_resize_pil",
                        lambda p, s=224: pil_calls.append(p) or pil(p, s))
    for path in (jpg, png):
        out = transforms.decode_resize_uint8(path)
        assert out.dtype == np.uint8 and out.shape == (224, 224, 3)
        np.testing.assert_array_equal(out, _pil(path))
    assert pil_calls == [png]


@pytest.mark.parametrize("how", ["build_fails", "switched_off"])
def test_unavailable_library_says_why_and_falls_back(how, tmp_path,
                                                     monkeypatch, caplog):
    lib = image_cpp.NativeLibrary(tmp_path / "build")
    monkeypatch.setattr(image_cpp, "LIBRARY", lib)
    if how == "build_fails":
        monkeypatch.setattr(image_cpp, "CXX_FLAGS", image_cpp.CXX_FLAGS + (
            "-include", "artdata_no_such_header.h"))
        monkeypatch.delenv("ARTGRAPH_NO_NATIVE", raising=False)
    else:
        monkeypatch.setenv("ARTGRAPH_NO_NATIVE", "1")
    jpg, png = _jpeg_and_png(tmp_path)
    with caplog.at_level(logging.WARNING, logger=image_cpp.__name__):
        for path in (jpg, png, jpg):
            np.testing.assert_array_equal(transforms.decode_resize_uint8(path),
                                          _pil(path))
    assert not native_available()
    assert decode_resize_native(jpg, 224) is None
    assert decode_batch_native([jpg], 224) is None
    reason = native_reason()
    if how == "build_fails":
        assert "g++ failed" in reason and "artdata_no_such_header.h" in reason
    else:
        assert reason == "ARTGRAPH_NO_NATIVE is set"
    warned = [r for r in caplog.records if r.name == image_cpp.__name__]
    assert len(warned) == 1 and reason in warned[0].getMessage()
    assert not list((tmp_path / "build").glob("*.so"))
