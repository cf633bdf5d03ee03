"""Geometry cache management (the torch port's counterpart of
bin/chroma-geo; host only, so it has no --device):

    python -m chroma_tpu_torch.cli.geo save @chroma_tpu_torch.demo.tiny [NAME]
    python -m chroma_tpu_torch.cli.geo {list,remove NAME,default NAME}
"""
import argparse
import sys


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Manage the on-disk geometry cache.')
    sub = parser.add_subparsers(dest='command', required=True)

    p = sub.add_parser('save', help='build a geometry and cache it')
    p.add_argument('obj', help='geometry string (STL or @module.obj)')
    p.add_argument('name', nargs='?', default=None)

    sub.add_parser('list', help='list cached geometries')

    p = sub.add_parser('remove', help='remove a cached geometry')
    p.add_argument('name')

    p = sub.add_parser('default', help='set the default geometry')
    p.add_argument('name')

    args = parser.parse_args(argv)

    from chroma_tpu_torch.cache import Cache
    cache = Cache()

    if args.command == 'save':
        from chroma_tpu_torch.loader import load_geometry_from_string
        geometry = load_geometry_from_string(args.obj)
        name = args.name
        if name is None:
            name = args.obj.replace('@', '').replace('.', '_')
        cache.save_geometry(name, geometry)
        print('cached geometry as %r' % name)
    elif args.command == 'list':
        for name in sorted(cache.list_geometry()):
            print(name)
    elif args.command == 'remove':
        cache.remove_geometry(args.name)
    elif args.command == 'default':
        cache.set_default_geometry(args.name)
    else:
        sys.exit(1)


if __name__ == '__main__':
    main()
