"""BVH cache management and statistics (the torch port's counterpart of
bin/chroma-bvh; host only, so it has no --device):

    python -m chroma_tpu_torch.cli.bvh create DETECTOR [NAME] [--degree D]
    python -m chroma_tpu_torch.cli.bvh {stat,list,remove,sort} DETECTOR ...
    python -m chroma_tpu_torch.cli.bvh optimize DETECTOR LAYER [NAME]
"""
import argparse
import time


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Create, inspect and manage BVHs.')
    sub = parser.add_subparsers(dest='command', required=True)

    p = sub.add_parser('create', help='build a BVH for a cached geometry')
    p.add_argument('geometry', help='geometry string')
    p.add_argument('name', nargs='?', default='default')
    p.add_argument('--degree', type=int, default=3)

    p = sub.add_parser('stat', help='print BVH statistics')
    p.add_argument('geometry', help='geometry string')
    p.add_argument('name', nargs='?', default='default')

    p = sub.add_parser('list', help='list BVHs for a geometry')
    p.add_argument('geometry', help='geometry string')

    p = sub.add_parser('remove', help='remove a cached BVH')
    p.add_argument('geometry', help='geometry string')
    p.add_argument('name', nargs='?', default='default')

    p = sub.add_parser('sort', help="sort every node's children by area "
                       '(big children first, better early pruning)')
    p.add_argument('geometry', help='geometry string')
    p.add_argument('name', nargs='?', default='default')

    p = sub.add_parser('optimize', help='surface-area-minimizing node '
                       'swaps within a layer, then rebuild the layers '
                       'above (reference: bin/chroma-bvh node_swap)')
    p.add_argument('geometry', help='geometry string')
    p.add_argument('layer', help="layer index, or 'N-' to optimize "
                   'layers N down to 2 in epochs')
    p.add_argument('name', nargs='?', default='default')
    p.add_argument('--sweeps', type=int, default=1)
    p.add_argument('--window', type=int, default=32)

    args = parser.parse_args(argv)

    from chroma_tpu_torch.cache import Cache
    from chroma_tpu_torch.loader import load_geometry_from_string
    cache = Cache()

    geometry = load_geometry_from_string(args.geometry,
                                         auto_build_bvh=False)
    mesh_hash = geometry.mesh.md5()

    if args.command == 'create':
        from chroma_tpu_torch.bvh import make_recursive_grid_bvh
        t0 = time.time()
        bvh = make_recursive_grid_bvh(geometry.mesh,
                                      target_degree=args.degree)
        print('BVH built in %.1f s' % (time.time() - t0))
        cache.save_bvh(bvh, mesh_hash, args.name)
    elif args.command == 'stat':
        bvh = cache.load_bvh(mesh_hash, args.name)
        print('nodes: %d  layers: %d' % (len(bvh), bvh.layer_count()))
        print('world scale: %f  origin: %s'
              % (bvh.world_coords.world_scale,
                 bvh.world_coords.world_origin))
        for i in range(bvh.layer_count()):
            layer = bvh.get_layer(i)
            print('  layer %2d: %8d nodes, area %.4e'
                  % (i, len(layer), layer.area()))
    elif args.command == 'list':
        for name in cache.list_bvh(mesh_hash):
            print(name)
    elif args.command == 'remove':
        cache.remove_bvh(mesh_hash, args.name)
    elif args.command == 'sort':
        from chroma_tpu_torch.bvh.build import area_sort_nodes
        bvh = cache.load_bvh(mesh_hash, args.name)
        print('Sorting BVH nodes by area...')
        bvh.nodes = area_sort_nodes(bvh.nodes, bvh.layer_bounds)
        cache.save_bvh(bvh, mesh_hash, args.name)
    elif args.command == 'optimize':
        from chroma_tpu_torch.bvh.build import optimize_layer, rebuild_above
        bvh = cache.load_bvh(mesh_hash, args.name)
        if args.layer.endswith('-'):
            top = int(args.layer[:-1])
            layers = list(range(top, 1, -1))
        else:
            layers = [int(args.layer)]
        for li in layers:
            if li < 1 or li > bvh.layer_count() - 1:
                print('Can only optimize layers 1..%d'
                      % (bvh.layer_count() - 1))
                return
            before = bvh.get_layer(li - 1).area()
            lo, hi = bvh.layer_bounds[li], bvh.layer_bounds[li + 1]
            bvh.nodes[lo:hi] = optimize_layer(bvh.nodes[lo:hi],
                                              max_sweeps=args.sweeps,
                                              window=args.window)
            bvh = rebuild_above(bvh, li)
            after = bvh.get_layer(li - 1).area()
            print('layer %2d: parent area %.4e -> %.4e (%+.1f%%)'
                  % (li, before, after, 100.0 * (after - before)
                     / max(before, 1e-30)))
        cache.save_bvh(bvh, mesh_hash, args.name)


if __name__ == '__main__':
    main()
