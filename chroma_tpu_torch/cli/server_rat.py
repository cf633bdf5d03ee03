"""ZeroMQ photon service speaking the RAT binary protocol (the torch
port's counterpart of bin/chroma-server-rat):

    python -m chroma_tpu_torch.cli.server_rat DETECTOR
        [-a ipc:///tmp/ipc_chroma] [--device cuda|cpu]
"""
import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Serve a chroma geometry on a ZeroMQ socket that '
                    'speaks the packed binary protocol RAT understands.')
    parser.add_argument('detector', help='geometry string')
    parser.add_argument('--address', '-a', default='ipc:///tmp/ipc_chroma')
    parser.add_argument('--device', default='cuda',
                        help='torch device to simulate on (default cuda)')
    args = parser.parse_args(argv)

    from chroma_tpu_torch.loader import load_geometry_from_string
    from chroma_tpu_torch.server import RatServer

    detector = load_geometry_from_string(args.detector)
    server = RatServer(args.address, detector, device=args.device)
    server.serve_forever()


if __name__ == '__main__':
    main()
