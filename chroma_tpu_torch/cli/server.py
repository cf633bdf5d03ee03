"""ZeroMQ photon propagation service (the torch port's counterpart of
bin/chroma-server):

    python -m chroma_tpu_torch.cli.server DETECTOR [--address tcp://*:5024]
        [--device cuda|cpu]
"""
import argparse


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Serve photon propagation over ZeroMQ '
                    '(pickled Photons REQ/REP).')
    parser.add_argument('detector', help='geometry string')
    parser.add_argument('--address', default='tcp://*:5024')
    parser.add_argument('--device', default='cuda',
                        help='torch device to simulate on (default cuda)')
    args = parser.parse_args(argv)

    from chroma_tpu_torch.loader import load_geometry_from_string
    from chroma_tpu_torch.server import PhotonServer

    print('reticulating splines...')
    detector = load_geometry_from_string(args.detector)
    print('starting chroma server listening on', args.address)
    server = PhotonServer(args.address, detector, device=args.device)
    server.serve_forever()


if __name__ == '__main__':
    main()
