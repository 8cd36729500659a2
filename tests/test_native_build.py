"""Guard against silent pure-Python fallback: the C host extension
must build and load in CI — a broken build would otherwise let every
suite silently pass on the (bit-identical but far slower) Python
oracles, hiding native-path regressions entirely.  Found the hard
way: an implicit-declaration error once made 500+ tests 'pass' on
the fallback."""


def test_native_extension_available():
    from ffpic_tpu import native
    assert native.available(), (
        "native C extension failed to build/load; run "
        "`cc -O3 -march=native -fPIC -shared ffpic_tpu/native/*.c` "
        "to see the compile error")


def test_native_cache_key_covers_flags_and_cpu():
    """A library built with other flags or on another CPU (a copied
    build/ directory) must not be found under this machine's key."""
    import os
    from ffpic_tpu import native
    srcs = [os.path.join(native._DIR, s) for s in native._SOURCES]
    flags = ["cc", "-O3", "-march=native"]
    base = native._so_path(srcs, flags, "cpu A")
    assert base == native._so_path(srcs, flags, "cpu A")
    assert base != native._so_path(srcs, flags, "cpu B")
    assert base != native._so_path(srcs, flags + ["-g"], "cpu A")
