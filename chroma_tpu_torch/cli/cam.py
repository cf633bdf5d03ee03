"""Geometry viewer (the torch port's counterpart of bin/chroma-cam):
interactive with a display, or a headless snapshot with -o.

    python -m chroma_tpu_torch.cli.cam DETECTOR [--size W H] [-o OUT.png]
        [--alpha-depth N] [--device cuda|cpu]
"""
import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(description='View a detector geometry.')
    parser.add_argument('detector', help='geometry string')
    parser.add_argument('--size', type=int, nargs=2, default=(800, 600))
    parser.add_argument('-o', '--output', default=None,
                        help='write a headless snapshot PNG and exit')
    parser.add_argument('--alpha-depth', type=int, default=12)
    parser.add_argument('--device', default='cuda',
                        help='torch device to render on (default cuda)')
    args = parser.parse_args(argv)

    from chroma_tpu_torch.loader import load_geometry_from_string
    geometry = load_geometry_from_string(args.detector)

    if args.output:
        from chroma_tpu_torch.camera import snapshot, save_png
        img = snapshot(geometry, size=tuple(args.size),
                       alpha_depth=args.alpha_depth, device=args.device)
        save_png(args.output, img)
        print('wrote %s' % args.output)
    else:
        from chroma_tpu_torch.camera import Camera
        cam = Camera(geometry, size=tuple(args.size),
                     alpha_depth=args.alpha_depth, device=args.device)
        cam.start()
        cam.join()


if __name__ == '__main__':
    main()
