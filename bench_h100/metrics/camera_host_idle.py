"""camera_host_idle: the card's idle time while the host's innermost
program span is the camera's or the renderer's (chroma.camera.*: the
pose, the rays built and uploaded, the pixels unpacked; chroma.render.*:
the depth-peeled render), in percent of the traced window."""
from bench_h100.harness import program


def read(run):
    return program.share(run, ('chroma.camera.', 'chroma.render.'))
